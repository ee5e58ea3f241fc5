"""How near the bf16 window-attention kernels (K7, K8) come to their plain
versions, and what their recheck costs, on one CUDA card.

    python -m polyphonicformer_torch.tools.window_attn_margins

The bf16 kernels of ``csrc/window_attn.cu`` recompute, in the plain
version's order, each row whose output could land more than one bf16 ulp
from the plain version's (``TAU``, ``P_NEAR*`` there).  This tool builds
that source three more times with its constants replaced: with the recheck
off, with every margin halved, and with a counter of the rows rechecked.
At each Swin-L stage shape of a 1024x2048 bf16 frame (K8 at stages 0 and 1,
K7 at stages 2 and 3, each with the shift mask and without; seeded random
qkv and bias, as ``chip_smoke.py`` phase 3), it prints one JSON line: the
outputs that differ from the plain version and those beyond one bf16 ulp,
for the kernel and each variant, the share of rows rechecked, and the
device time of the kernel and of the kernel without recheck (CUDA events
behind a ~1 ms ``torch.cuda._sleep``, median of 20).  Then the card's name
and power limit.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import torch

from ..models.swin import _shift_attn_mask, window_partition
from ..ops.cuda import _lib
from ..ops.cuda import window_attn as wa

CONSTANTS = ("constexpr float TAU = 0x1p-12f;", "constexpr int P_NEAR = 8;",
             "constexpr float P_NEAR_M = 4.f;", "constexpr float P_NEAR_X = 2.f;")
VARIANTS = {
    "no_recheck": ("constexpr float TAU = -1.f;", "constexpr int P_NEAR = -100000;",
                   CONSTANTS[2], CONSTANTS[3]),
    "half_margins": ("constexpr float TAU = 0x1p-13f;", "constexpr int P_NEAR = 4;",
                     "constexpr float P_NEAR_M = 2.f;", "constexpr float P_NEAR_X = 1.f;"),
}
COUNTER = ("__device__ unsigned long long g_rechecked;\n"
           "extern \"C\" unsigned long long poly_rechecked() {\n"
           "  unsigned long long v = 0, z = 0;\n"
           "  cudaMemcpyFromSymbol(&v, g_rechecked, 8);\n"
           "  cudaMemcpyToSymbol(g_rechecked, &z, 8);\n"
           "  return v;\n}\n")
MARKED = "  __syncwarp();\n  while (marked) {"
# Swin-L stages of a 1024x2048 frame: (stage, Hp, Wp, C, heads); K8 at 0-1, K7 at 2-3
STAGES = ((0, 259, 518, 192, 6), (1, 133, 259, 384, 12), (2, 70, 133, 768, 24),
          (3, 35, 70, 1536, 48))
WS = 7


def _sources() -> dict[str, str]:
    src = (_lib.CSRC / "window_attn.cu").read_text()
    for line in (*CONSTANTS, MARKED, "namespace {\n"):
        if line not in src:
            raise RuntimeError(f"csrc/window_attn.cu no longer holds {line!r}")
    out = {"kernel": src}
    for name, repl in VARIANTS.items():
        s = src
        for old, new in zip(CONSTANTS, repl):
            s = s.replace(old, new)
        out[name] = s
    out["counted"] = src.replace("namespace {\n", COUNTER + "namespace {\n", 1).replace(
        MARKED, "  if (lane == 0 && marked)\n"
        "    atomicAdd(&g_rechecked, (unsigned long long)__popc(marked));\n" + MARKED)
    return out


def _build() -> dict[str, ctypes.CDLL]:
    """One library per variant, nvcc in parallel, under the git-ignored
    build directory."""
    out_dir = _lib.BUILD_DIR / "window_attn_margins"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in _sources().items():
        cu = out_dir / f"{name}.cu"
        cu.write_text(src)
        procs[name] = subprocess.Popen(
            [_lib._nvcc(), *_lib.NVCC_FLAGS, "-shared", "-o", str(out_dir / f"{name}.so"),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    libs = {}
    for name, p in procs.items():
        _, err = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{err[-3000:]}")
        lib = ctypes.CDLL(str(out_dir / f"{name}.so"))
        for kern in (wa.KERNEL_MATH, wa.KERNEL_IMAGE):
            getattr(lib, kern.symbol).argtypes = [*kern.argtypes, _lib.P]
        libs[name] = lib
    libs["counted"].poly_rechecked.restype = ctypes.c_ulonglong
    return libs


def _launch(lib, image: bool, x, bias, mask, heads: int):
    """The bf16 kernel of ``lib`` on x (the image for K8, its windows for K7),
    with the wrapper's launch plan."""
    stream = torch.cuda.current_stream().cuda_stream
    c = x.shape[-1] // 3
    m = None if mask is None else mask.data_ptr()
    if image:
        b, hp, wp, _ = x.shape
        out = torch.empty((b, hp, wp, c), dtype=x.dtype, device=x.device)
        args = wa._plan_args(x, b * (hp // WS) * (wp // WS), heads, c, WS * WS, mask is not None)
        err = lib.poly_window_attention(x.data_ptr(), 1, bias.data_ptr(), m, out.data_ptr(), b,
                                        hp, wp, c, heads, WS, wa._scale(c // heads), *args,
                                        stream)
    else:
        nw, l, _ = x.shape
        out = torch.empty((nw, l, c), dtype=x.dtype, device=x.device)
        args = wa._plan_args(x, nw, heads, c, l, mask is not None)
        err = lib.poly_window_attn_math(x.data_ptr(), 1, bias.data_ptr(), m, out.data_ptr(), nw,
                                        l, c, heads, 1 if mask is None else mask.shape[0],
                                        wa._scale(c // heads), *args, stream)
    if err:
        raise RuntimeError(f"CUDA error {err} at launch")
    return out


def _beyond(got, want) -> dict:
    """Outputs that differ, and those beyond one bf16 spacing of the larger
    magnitude (the check of chip_smoke.py phase 3)."""
    d = (got.float() - want.float()).abs()
    _, e = torch.frexp(torch.maximum(got.float().abs(), want.float().abs()))
    ulp = torch.ldexp(torch.ones_like(d), e - 8)
    return {"differ": int((got != want).sum()), "beyond_ulp": int((d > ulp).sum())}


def _time_ms(fn, reps: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[len(times) // 2]


def main() -> int:
    if not torch.cuda.is_available():
        print("window_attn_margins: no CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    libs = _build()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    l = WS * WS
    for stage, hp, wp, c, heads in STAGES:
        qkv = torch.randn((1, hp, wp, 3 * c), generator=gen, device=dev).to(torch.bfloat16)
        bias = torch.randn((heads, l, l), generator=gen, device=dev) * 0.5
        shift = torch.from_numpy(_shift_attn_mask(hp, wp, WS, WS // 2)).to(dev)
        image = stage < 2
        x = qkv if image else window_partition(qkv, WS).contiguous()
        for mask in (shift, None):
            if image:
                want = wa.window_attention_plain(x, bias, mask, heads, WS)
            else:
                want = wa.window_attn_math_plain(x, bias, mask, heads)
            rec = {"kernel": "window_attention" if image else "window_attn_math",
                   "stage": stage, "mask": mask is not None, "outputs": want.numel()}
            for name in ("kernel", *VARIANTS):
                rec[name] = _beyond(_launch(libs[name], image, x, bias, mask, heads), want)
            libs["counted"].poly_rechecked()
            _launch(libs["counted"], image, x, bias, mask, heads)
            torch.cuda.synchronize()
            rows = want.numel() // (c // heads)
            rec["rows_rechecked"] = libs["counted"].poly_rechecked() / rows
            for name in ("kernel", "no_recheck"):
                rec[f"ms_{name}"] = _time_ms(
                    lambda: _launch(libs[name], image, x, bias, mask, heads))
            print(json.dumps(rec), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi: n/a")
    return 0


if __name__ == "__main__":
    sys.exit(main())
