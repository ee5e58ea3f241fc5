"""Single-kernel measurements on one CUDA card, beside ``chip_smoke.py``.

    python -m polyphonicformer_torch.tools.kernel_probe [--parts a,b,...]

Parts (all by default), one JSON line each, then the card's name and power
limit:

* ``res_usage``: registers, stack and local (spill) bytes a thread of the
  K2b, K3, K5 (each CPL instance), K6 and K6b kernels of the built
  library, from ``cuobjdump -res-usage``;
* ``k6``: K6 and K6b through the public ``mask_loss_stats`` and autograd's
  backward at the train step's two shapes (the stages' (3, 111, 256, 512)
  and the rpn head's (1, 100, 256, 512)): within the tolerances of the
  plain version, device ms (median of 20) beside the plain version's and
  the byte bound (the function's inputs and outputs: m, t, pos, valid,
  lbl and stats, dice; m, t, pos, valid, lbl, the cotangents and dm);
* ``k6_instructions``: the SASS instructions of K6's and K6b's main loop
  (the largest loop of each vector-path kernel in ``cuobjdump -sass``),
  per element (a loop iteration covers GROUP or DEPTH queries of PPT
  pixels, constants read from the source), and the floor they imply at
  the stages' shape at 33.5 T instructions/s;
* ``k5``: K5's latency bound and its costs: the Dijkstra steps of each
  problem (counted by the plain solver) at phase 3's distribution (16
  problems of 64 x 100) and at the problems of one full-width
  ``image_r50_2x`` train step (seeded weights and batch, as phase 5,
  recorded at the solver's entry: the raw strided costs where the solver
  prepares them itself), times the least time of one step: one warp-wide
  argmin of P values (CPL a lane, no barrier), the faster of two probe
  kernels that run only a chain of them, one over a packed 64-bit key in
  five ``__shfl_xor_sync`` rounds, one in two ``__reduce_min_sync`` (K5's
  form); beside the old bound (a block-wide argmin with one
  ``__syncthreads`` a step, the design K5 had before) and K5's
  own time; and K5's cost a row apart from its cost a step: K5 on the
  same shapes and valid rows with no valid row (``empty_ms``) and with
  diagonal costs, where each row takes one step (``diagonal_ms``);
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

The parts ``res_usage``, ``k2b``, ``wrapper_host``, ``k6`` and ``k5`` use only
entry points that earlier versions of the package have too, so the tool can
be copied into an older checkout and run there to compare the two.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

PARTS = ("res_usage", "k2b", "wrapper_host", "k3_atomics", "k6", "k6_instructions", "k5")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
INSTR_PER_S = 33.5e12  # one instruction a lane and clock: 132 SMs x 128 lanes x 1.98 GHz
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


def _cuobjdump(flag: str, so_path) -> str:
    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    return subprocess.run([tool, flag, str(so_path)], capture_output=True, text=True,
                          check=True).stdout


def res_usage(so_path=None) -> dict:
    """Registers, stack, shared and local bytes a thread of the probed
    kernels in ``so_path`` (default: the package's built library)."""
    from polyphonicformer_torch.ops.cuda import _lib

    if so_path is None:
        _lib.load()
        so_path = _lib.library_path()
    out = _cuobjdump("-res-usage", so_path)
    found, fn = {}, None
    for line in out.splitlines():
        m = re.search(r"Function (\S+):", line)
        if m:
            fn = m.group(1)
            continue
        name = fn and re.search(r"\d+(upsample_int_bwd(?:_band)?|phase_fusion_kernel|mask_loss_fwd"
                                r"(?:_partial|_finish)?|mask_loss_bwd|lsa_kernel)(?:IL[ib](\d+)E)?", fn)
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


# K6 / K6b at the train step's two calls: the three refinement stages and
# the rpn head
K6_SHAPES = ((3, 111, 256, 512), (1, 100, 256, 512))


def _k6_inputs(dev, shape):
    import torch

    n, q, h, w = shape
    gen = torch.Generator(device=dev).manual_seed(6)
    m = torch.randn(shape, generator=gen, device=dev) * 3
    t = (torch.rand(shape, generator=gen, device=dev) < 0.2).float()
    pos = (torch.rand((n, q), generator=gen, device=dev) < 0.3).float()
    valid = (torch.rand((n, h, w), generator=gen, device=dev) < 0.9).float()
    lbl = torch.randint(0, q, (n, h, w), generator=gen, device=dev, dtype=torch.int32)
    lbl[torch.rand((n, h, w), generator=gen, device=dev) < 0.2] = 255
    gs = torch.randn((n, 2), generator=gen, device=dev)
    gd = torch.randn((n, 3, q), generator=gen, device=dev)
    return m, t, pos, valid, lbl, gs, gd


def k6(dev) -> dict:
    import torch

    from polyphonicformer_torch.ops.cuda import mask_loss

    out = {}
    for shape in K6_SHAPES:
        m, t, pos, valid, lbl, gs, gd = _k6_inputs(dev, shape)
        mr = m.clone().requires_grad_()
        stats, dice = mask_loss.mask_loss_stats(mr, t, pos, valid, lbl)
        (dm,) = torch.autograd.grad((stats, dice), mr, (gs, gd), retain_graph=True)
        ws, wd = mask_loss.mask_loss_stats_plain(m, t, pos, valid, lbl)[:2]
        want = mask_loss.mask_loss_grad_plain(m, t, pos, valid, lbl, gs, gd)
        ok = (bool(((stats - ws).abs() <= 1e-5 * ws.abs()).all())
              and bool(((dice - wd).abs() <= 1e-5 * wd.abs()).all())
              and bool(((dm - want).abs() <= 1e-7 + 1e-5 * want.abs()).all()))
        fwd_bytes = sum(x.numel() * 4 for x in (m, t, pos, valid, lbl, stats, dice))
        bwd_bytes = sum(x.numel() * 4 for x in (m, t, pos, valid, lbl, gs, gd, dm))
        out[str(shape)] = {
            "within_tolerance": ok, "dm_bit_equal": bool(torch.equal(dm, want)),
            "fwd_ms": time_ms(lambda: mask_loss.mask_loss_stats(mr, t, pos, valid, lbl)),
            "bwd_ms": time_ms(lambda: torch.autograd.grad((stats, dice), mr, (gs, gd),
                                                          retain_graph=True)),
            "plain_fwd_ms": time_ms(lambda: mask_loss.mask_loss_stats_plain(m, t, pos, valid, lbl),
                                    reps=3),
            "plain_bwd_ms": time_ms(
                lambda: mask_loss.mask_loss_grad_plain(m, t, pos, valid, lbl, gs, gd), reps=3),
            "fwd_bound_us": fwd_bytes / HBM_BYTES_PER_S * 1e6,
            "bwd_bound_us": bwd_bytes / HBM_BYTES_PER_S * 1e6}
        del m, mr, t, dm, want, stats, dice
        torch.cuda.empty_cache()
    return out


def sass_main_loop(sass: str) -> dict:
    """Per kernel of a ``cuobjdump -sass`` listing: the instructions of its
    largest loop (a backward branch and its target) and their opcodes."""
    out = {}
    for part in re.split(r"\n\s*Function : ", sass)[1:]:
        name = part.split("\n")[0].strip()
        ins = [(int(a, 16), t.strip()) for a, t in
               re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*?)\s*;", part)]
        body = []
        for addr, text in ins:
            b = re.search(r"\bBRA\s+(?:`\()?0x([0-9a-f]+)", text)
            if b and int(b.group(1), 16) < addr:
                loop = [t for a, t in ins if int(b.group(1), 16) <= a <= addr]
                body = loop if len(loop) > len(body) else body
        ops = [re.sub(r"^@!?U?P\w+\s+", "", t).split()[0].split(".")[0] for t in body]
        out[name] = {"loop_instructions": len(body), "total_instructions": len(ins),
                     **{op.lower(): ops.count(op) for op in ("MUFU", "SHFL", "LDG", "STG")}}
    return out


def k6_instructions(so_path=None, src: str | None = None) -> dict:
    """K6's and K6b's main-loop instructions an element in ``so_path``
    built from ``src`` (default: the package's library and source)."""
    from polyphonicformer_torch.ops.cuda import _lib

    if so_path is None:
        _lib.load()
        so_path = _lib.library_path()
    sass = _cuobjdump("-sass", so_path)
    src = (_lib.CSRC / "mask_loss.cu").read_text() if src is None else src
    const = {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);", src)}
    elements = {"mask_loss_fwd": const["GROUP"] * const["PPT"],
                "mask_loss_bwd": const["DEPTH"] * const["PPT"]}
    stage_elements = 3 * 111 * 256 * 512
    out = {}
    for fn, loop in sass_main_loop(sass).items():
        m = re.search(r"\d+(mask_loss_fwd|mask_loss_bwd)ILb1E", fn)  # the float4 path
        if not m:
            continue
        per = loop["loop_instructions"] / elements[m.group(1)]
        out[m.group(1)] = {**loop, "elements_per_iteration": elements[m.group(1)],
                           "instructions_per_element": per,
                           "instruction_floor_us_stages": per * stage_elements / INSTR_PER_S * 1e6}
    return out


# the argmin chains of K5's Dijkstra steps alone, each step's input depending
# on the previous step's result.  "block": the design K5 had before, a
# block-wide argmin (warp shuffles, one __syncthreads, every thread folds
# the warps' results).  The least a step needs is one warp-wide argmin of P
# values, CPL a lane, over csrc/lsa.cu's key (the ordered value, then the
# column), no barrier: "butterfly" takes the least 64-bit key in five xor
# shuffle rounds, "redux" in two __reduce_min_sync (the value, then the
# column among the lanes that hold it), as K5 does.
_ARGMIN_CHAINS = r"""
#include <cuda_runtime.h>
struct ArgMin { float v; int j; };
__device__ __forceinline__ ArgMin better(ArgMin a, ArgMin b) {
  return (b.v < a.v || (b.v == a.v && b.j < a.j)) ? b : a;
}
__global__ void block_chain(const float* vals, int P, int steps, float* out) {
  __shared__ ArgMin best[2][32];
  const int t = threadIdx.x, nw = (blockDim.x + 31) / 32;
  const float x = t < P ? vals[blockIdx.x * P + t] : 1e30f;
  float carry = 0.f;
  for (int s = 0; s < steps; ++s) {
    ArgMin a = {t < P ? __fadd_rn(x, carry) : 1e30f, t};
    for (int off = 16; off > 0; off >>= 1) {
      ArgMin o;
      o.v = __shfl_down_sync(0xffffffffu, a.v, off);
      o.j = __shfl_down_sync(0xffffffffu, a.j, off);
      a = better(a, o);
    }
    if ((t & 31) == 0) best[s & 1][t >> 5] = a;
    __syncthreads();
    ArgMin b = best[s & 1][0];
    for (int w = 1; w < nw; ++w) b = better(b, best[s & 1][w]);
    carry = b.v * 1e-30f;
  }
  if (t == 0) out[blockIdx.x] = carry;
}
// the lane's first least value of its CPL slots: (ordered value, column)
template <int CPL>
__device__ __forceinline__ void lane_min(const float* x, float carry, int P, int lane,
                                         unsigned& m, unsigned& j) {
  m = ~0u;
  j = 0;
#pragma unroll
  for (int s = 0; s < CPL; ++s) {
    const unsigned b = __float_as_uint(__fadd_rn(__fadd_rn(x[s], carry), 0.f));
    const unsigned o = s * 32 + lane < P ? ((b & 0x80000000u) ? ~b : (b | 0x80000000u)) : ~0u;
    if (o < m) {
      m = o;
      j = s * 32 + lane;
    }
  }
}
__device__ __forceinline__ float from_ordered(unsigned m) {
  return __uint_as_float((m & 0x80000000u) ? (m & 0x7fffffffu) : ~m);
}
template <int CPL, bool REDUX>
__global__ void warp_chain(const float* vals, int P, int steps, float* out) {
  const int lane = threadIdx.x;
  float x[CPL];
#pragma unroll
  for (int s = 0; s < CPL; ++s) x[s] = s * 32 + lane < P ? vals[blockIdx.x * P + s * 32 + lane] : 0.f;
  float carry = 0.f;
  for (int t = 0; t < steps; ++t) {
    unsigned m, j;
    lane_min<CPL>(x, carry, P, lane, m, j);
    if (REDUX) {
      const unsigned mm = __reduce_min_sync(0xffffffffu, m);
      j = __reduce_min_sync(0xffffffffu, m == mm ? j : ~0u);
      m = mm;
    } else {
      unsigned long long key = ((unsigned long long)m << 32) | j;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const unsigned long long o = __shfl_xor_sync(0xffffffffu, key, off);
        key = o < key ? o : key;
      }
      m = (unsigned)(key >> 32);
      j = (unsigned)key;
    }
    carry = from_ordered(m) * 1e-30f + (float)(j & 1u) * 1e-38f;
  }
  if (lane == 0) out[blockIdx.x] = carry;
}
template <bool REDUX>
int warp_chain_launch(const float* v, int n, int P, int steps, float* o, cudaStream_t st) {
  if (P <= 32) warp_chain<1, REDUX><<<n, 32, 0, st>>>(v, P, steps, o);
  else if (P <= 64) warp_chain<2, REDUX><<<n, 32, 0, st>>>(v, P, steps, o);
  else if (P <= 128) warp_chain<4, REDUX><<<n, 32, 0, st>>>(v, P, steps, o);
  else if (P <= 256) warp_chain<8, REDUX><<<n, 32, 0, st>>>(v, P, steps, o);
  else if (P <= 512) warp_chain<16, REDUX><<<n, 32, 0, st>>>(v, P, steps, o);
  else warp_chain<32, REDUX><<<n, 32, 0, st>>>(v, P, steps, o);
  return (int)cudaGetLastError();
}
extern "C" int block_chain_launch(const void* vals, int n, int P, int steps, void* out,
                                  void* stream) {
  block_chain<<<n, (P + 31) / 32 * 32, 0, (cudaStream_t)stream>>>((const float*)vals, P, steps,
                                                                  (float*)out);
  return (int)cudaGetLastError();
}
extern "C" int butterfly_chain_launch(const void* vals, int n, int P, int steps, void* out,
                                      void* stream) {
  return warp_chain_launch<false>((const float*)vals, n, P, steps, (float*)out,
                                  (cudaStream_t)stream);
}
extern "C" int redux_chain_launch(const void* vals, int n, int P, int steps, void* out,
                                  void* stream) {
  return warp_chain_launch<true>((const float*)vals, n, P, steps, (float*)out,
                                 (cudaStream_t)stream);
}
"""
_chains = None


WARP_KINDS = ("butterfly", "redux")


def warp_step_us(dev, n: int, p: int) -> float:
    """The least time of one warp-wide argmin step: the faster chain."""
    return min(argmin_step_us(dev, k, n, p) for k in WARP_KINDS)


def argmin_step_us(dev, kind: str, n: int, p: int) -> float:
    """Device microseconds of one step of the ``kind`` ("block",
    "butterfly" or "redux") argmin chain over n problems of P values: the
    difference of 20,000- and 2,000-step runs over 18,000."""
    import ctypes

    import torch

    from polyphonicformer_torch.ops.cuda import _lib

    global _chains
    if _chains is None:
        _lib.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        src = _lib.BUILD_DIR / "argmin_chains.cu"
        so = _lib.BUILD_DIR / "libargmin_chains.so"
        src.write_text(_ARGMIN_CHAINS)
        subprocess.run([_lib._nvcc(), *_lib.NVCC_FLAGS, "-shared", "-o", str(so), str(src)],
                       check=True, capture_output=True)
        _chains = ctypes.CDLL(str(so))
    fn = getattr(_chains, f"{kind}_chain_launch")
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p]
    vals = torch.rand((n, p), device=dev)
    out = torch.empty(n, device=dev)

    def run(steps):
        err = fn(vals.data_ptr(), n, p, steps, out.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{kind}_chain: CUDA error {err}")

    return (time_ms(lambda: run(20000)) - time_ms(lambda: run(2000))) / 18000 * 1e3


def _phase3_lsa_problems(dev):
    """Phase 3's distribution of K5 problems: 16 of 64 GT x 100
    predictions, 12-40 valid rows, some invalid rows between valid ones."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(5)
    costs = torch.randn((16, 64, 100), generator=gen, device=dev) * 2
    counts = torch.randint(12, 41, (16,), generator=gen, device=dev)
    valid = torch.arange(64, device=dev)[None] < counts[:, None]
    holes = torch.rand((16, 64), generator=gen, device=dev) < 0.15
    valid = valid & ~(holes & (torch.arange(64, device=dev) < 10))
    costs = torch.where(valid[:, :, None], costs, 0.0)
    return costs.contiguous(), valid


def _train_step_lsa_problems(dev):
    """The costs and validity of the one K5 launch of a full-width
    image_r50_2x train step (as phase 5 of chip_smoke.py: seeded weights,
    synthetic batch), recorded at the solver's entry with their strides:
    the raw transposed view where the kernel prepares the costs itself,
    the prepared contiguous costs in a tree that prepares them before it."""
    import torch

    from polyphonicformer_torch.configs import preset
    from polyphonicformer_torch.data.synthetic import synthetic_batch
    from polyphonicformer_torch.models import PolyphonicFormer
    from polyphonicformer_torch.ops import hungarian
    from polyphonicformer_torch.train.step import create_train_state, make_train_step

    cfg = preset("image_r50_2x")
    gen = torch.Generator(device=dev).manual_seed(0)
    with torch.device("meta"):
        model = PolyphonicFormer(cfg.model)
    state, opt = create_train_state(model, cfg, gen, steps_per_epoch=1000, device=dev)
    step = make_train_step(state.model, cfg, opt)
    batch = synthetic_batch(cfg.model, 1, (1024, 2048), seed=0, max_instances=24, device=dev)
    seen, solve = [], hungarian.solve_lsa

    def recording(costs, valid):
        seen.append((costs.clone(), valid.clone()))
        return solve(costs, valid)

    hungarian.solve_lsa = recording
    try:
        step(state, batch)
        torch.cuda.synchronize()
    finally:
        hungarian.solve_lsa = solve
    return seen


def k5(dev) -> dict:
    """K5 at phase 3's and the train step's problems: its time beside its
    latency bound (the longest problem's Dijkstra steps x one warp argmin
    step; the old block-argmin bound beside it), and its cost a row
    (``us_per_row``: the diagonal problems, one step a row, less the
    problems with no valid row, over the most valid rows of a problem)
    apart from its cost a further step (``us_per_extra_step``: the recorded
    problems less the diagonal ones, over the longest problem's steps
    beyond one a row)."""
    import torch

    from polyphonicformer_torch.ops.cuda import lsa

    problems = {"phase3": [_phase3_lsa_problems(dev)],
                "train_step": _train_step_lsa_problems(dev)}
    out, step_us = {}, {}
    for name, calls in problems.items():
        for i, (costs, valid) in enumerate(calls):
            n, g, p = costs.shape
            if p not in step_us:
                step_us[p] = {k: argmin_step_us(dev, k, n, p) for k in ("block", *WARP_KINDS)}
                step_us[p]["warp"] = min(step_us[p][k] for k in WARP_KINDS)
            steps = []
            lsa.solve_lsa_plain(costs.cpu(), valid.cpu(), steps)
            rows = valid.sum(dim=1).tolist()
            diag = torch.ones_like(costs)  # the same strides
            diag.diagonal(dim1=1, dim2=2).zero_()
            ms = time_ms(lambda: lsa.solve_lsa(costs, valid))
            empty_ms = time_ms(lambda: lsa.solve_lsa(costs, torch.zeros_like(valid)))
            diag_ms = time_ms(lambda: lsa.solve_lsa(diag, valid))
            longest = max(range(n), key=lambda k: steps[k])
            extra = steps[longest] - rows[longest]
            bound_us = max(steps) * step_us[p]["warp"]
            out[f"{name}[{i}]"] = {
                "problems": [n, g, p], "valid_rows": rows, "dijkstra_steps": steps,
                "warp_argmin_step_us": step_us[p]["warp"],
                "butterfly_step_us": step_us[p]["butterfly"], "redux_step_us": step_us[p]["redux"],
                "latency_bound_us": bound_us,
                "block_argmin_step_us": step_us[p]["block"],
                "block_latency_bound_us": max(steps) * step_us[p]["block"],
                "k5_ms": ms, "share_of_latency_bound": bound_us / (ms * 1e3),
                "k5_us_per_step_of_longest": ms * 1e3 / max(steps),
                "empty_ms": empty_ms, "diagonal_ms": diag_ms,
                "us_per_row": (diag_ms - empty_ms) * 1e3 / max(max(rows), 1),
                "us_per_extra_step": (ms - diag_ms) * 1e3 / extra if extra else None,
                "bytes_bound_us": sum(x.numel() * x.element_size()
                                      for x in (costs, valid)) / HBM_BYTES_PER_S * 1e6}
    return out


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
           "wrapper_host": lambda: wrapper_host(dev), "k3_atomics": lambda: k3_atomics(dev),
           "k6": lambda: k6(dev), "k6_instructions": k6_instructions, "k5": lambda: k5(dev)}
    for part in args.parts.split(","):
        print(json.dumps({"part": part, **fns[part]()}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
