"""Single-kernel measurements on one CUDA card, beside ``chip_smoke.py``.

    python -m polyphonicformer_torch.tools.kernel_probe [--parts a,b,...]

Parts (all by default), one JSON line each, then the card's name and power
limit:

* ``res_usage``: registers, stack and local (spill) bytes a thread of the
  K2b and K3 kernels of the built library, from ``cuobjdump -res-usage``;
* ``k2b``: K2b (``upsample_int_bwd``) through its wrapper at the train
  step's four x2 gradients and at two x4 gradients (``K2B_SHAPES``):
  bit-equal to the plain version, device ms (CUDA events, median of 20)
  beside ``aten.upsample_bilinear2d_backward`` and the byte bound;
* ``wrapper_host``: host microseconds a call of the K7 and K8 wrappers
  takes under ``torch.no_grad`` (as serving calls them) at the Swin-L
  stage-2 and stage-0 shapes, bf16, with the card kept busy so that no
  call waits for it: the median and least over 11 rounds of 100 calls;
* ``k3_atomics``: the global atomics one K3 call issues at the serving
  shape (111 x (256, 512) bf16, 64 full rows, x4), counted from its winners:
  one per nonzero (candidate, row) and (candidate, column) of each block
  and at most one per full row and block for the area; beside the same
  count for the kernel K3 had before (blocks of one stride-4 row x 128
  stride-4 columns, one column atomic per counted pixel).

The parts ``res_usage``, ``k2b`` and ``wrapper_host`` use only entry
points that earlier versions of the package have too, so the tool can be
copied into an older checkout and run there to compare the two.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

PARTS = ("res_usage", "k2b", "wrapper_host", "k3_atomics")
SLEEP_CYCLES = 2_000_000  # ~1 ms of device clock queued ahead of each timed call


def time_ms(fn, reps: int = 20) -> float:
    """Median device ms of ``fn`` over ``reps`` warm runs, each queued
    behind a device sleep so the events time the card, not the host."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[reps // 2]


def res_usage() -> dict:
    from polyphonicformer_torch.ops.cuda import _lib

    _lib.load()
    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    out = subprocess.run([tool, "-res-usage", str(_lib.library_path())], capture_output=True,
                         text=True, check=True).stdout
    found, fn = {}, None
    for line in out.splitlines():
        m = re.search(r"Function (\S+):", line)
        if m:
            fn = m.group(1)
            continue
        name = fn and re.search(r"\d+(upsample_int_bwd(?:_band)?|phase_fusion_kernel)(?:ILi(\d)E)?",
                                fn)
        if name and "REG:" in line:
            key = name.group(1) + (f"<{name.group(2)}>" if name.group(2) else "")
            found[key] = {k: int(v) for k, v in re.findall(r"(REG|STACK|LOCAL|SHARED):(\d+)",
                                                           line)}
    return found


# K2b's gradients (n, H, W) and factors: the train step's four x2 launches
# (1 + 3 stages x 111 mask logits, 19 semantic logits, 3 stage depths, 1
# depth), and x4 at the serving depth map's size
K2B_SHAPES = ((2, 444, 256, 512), (2, 19, 256, 512), (2, 3, 256, 512), (2, 1, 256, 512),
              (4, 19, 1024, 2048), (4, 1, 1024, 2048))


def _k2b_inputs(dev):
    import torch

    gen = torch.Generator(device=dev).manual_seed(0)
    for f, n, hh, ww in K2B_SHAPES:
        yield f"x{f} ({n}, {hh}, {ww})", f, torch.randn((n, hh, ww), generator=gen, device=dev)


def k2b(dev) -> dict:
    import torch

    from polyphonicformer_torch.ops.cuda import upsample2

    out = {}
    for name, f, g in _k2b_inputs(dev):
        n, hh, ww = g.shape
        got = upsample2._upsample_int_bwd_cuda(g, f, f)
        lib_args = (g[:, None], [hh, ww], [n, 1, hh // f, ww // f], False, float(f), float(f))
        out[name] = {
            "bit_equal": bool(torch.equal(got, upsample2.upsample_int_bwd_plain(g, f, f))),
            "ms": time_ms(lambda: upsample2._upsample_int_bwd_cuda(g, f, f)),
            "library_ms": time_ms(
                lambda: torch.ops.aten.upsample_bilinear2d_backward(*lib_args)),
            "bytes_bound_ms": (g.numel() + got.numel()) * 4 / 3.35e12 * 1e3}
    return out


def wrapper_host(dev) -> dict:
    import torch

    from polyphonicformer_torch.ops.cuda import window_attn

    gen = torch.Generator(device=dev).manual_seed(0)

    def inputs(shape, heads, nmask):
        qkv = (torch.randn(shape, generator=gen, device=dev) * 0.5).to(torch.bfloat16)
        bias = torch.randn((heads, 49, 49), generator=gen, device=dev)
        mask = torch.where(torch.rand((nmask, 49, 49), generator=gen, device=dev) < 0.3,
                           -100.0, 0.0)
        return qkv, bias, mask

    q7, b7, m7 = inputs((190, 49, 2304), 24, 190)
    q8, b8, m8 = inputs((1, 259, 518, 576), 6, 2738)
    calls = {"window_attn_math": lambda: window_attn.window_attn_math(q7, b7, m7, 24),
             "window_attention": lambda: window_attn.window_attention(q8, b8, m8, 6, 7)}
    out = {}
    with torch.no_grad():
        for name, fn in calls.items():
            fn()
            torch.cuda.synchronize()
            rounds = []
            for _ in range(11):
                torch.cuda._sleep(200_000_000)  # ~0.1 s: the card stays busy
                t0 = time.perf_counter()
                for _ in range(100):
                    fn()
                rounds.append((time.perf_counter() - t0) / 100 * 1e6)
                torch.cuda.synchronize()
            out[name] = {"host_us_per_call": sorted(rounds)[5], "min_us": min(rounds),
                         "rounds_us": rounds}
    return out


def k3_atomics(dev) -> dict:
    import torch

    from polyphonicformer_torch.ops.cuda import phase_fusion

    gen = torch.Generator(device=dev).manual_seed(0)
    probs = torch.sigmoid(torch.randn((111, 256, 512), generator=gen, device=dev) * 3)
    probs = probs.to(torch.bfloat16)
    scores = torch.rand((111,), generator=gen, device=dev)
    depth = (torch.rand((111, 256, 512), generator=gen, device=dev) * 70 + 1).to(torch.bfloat16)
    pix = phase_fusion.phase_fusion(probs, scores, depth, 4, 4, n_full=64)[0]
    f, (hs, ws) = 4, probs.shape[1:]
    _, _, kf = phase_fusion._rows(probs.shape[0], 64)
    h, w = pix.shape
    r = torch.arange(h, device=dev)[:, None].expand(h, w)
    c = torch.arange(w, device=dev)[None, :].expand(h, w)
    k = pix.long()
    on = pix < kf

    def pairs(a, b):  # distinct (a, b, candidate) among the counted pixels
        return int(torch.unique(((a * (b.max() + 1) + b) * kf + k)[on]).numel())

    gx, gy = phase_fusion.launch_plan(112, 64, hs, ws, f).grid
    design = {"rows": pairs(r, c // (phase_fusion.TILE_W * f)),
              "cols": pairs(c, r // (phase_fusion.TILE_H * f)), "area_at_most": gx * gy * kf}
    before = {"rows": pairs(r, c // (128 * f)), "cols": int(on.sum()),
              "area_at_most": -(-ws // 128) * hs * kf}
    for d in (design, before):
        d["total_at_most"] = sum(d.values())
    return {"design": design, "replaced_design": before}


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parts", default=",".join(PARTS))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_probe: no CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    fns = {"res_usage": res_usage, "k2b": lambda: k2b(dev),
           "wrapper_host": lambda: wrapper_host(dev), "k3_atomics": lambda: k3_atomics(dev)}
    for part in args.parts.split(","):
        print(json.dumps({"part": part, **fns[part]()}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
