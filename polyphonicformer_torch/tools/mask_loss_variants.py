"""What each design decision of K6 and K6b is worth, on one CUDA card.

    python -m polyphonicformer_torch.tools.mask_loss_variants

Builds ``csrc/mask_loss.cu`` as it stands and with one or more of its
decisions undone (``VARIANTS``: ``log1pf`` and ``__frcp_rn`` in place of
the polynomial log1p and the reciprocal's fast path, more queries a warp
reduction, more queries loaded ahead, no cap of three forward blocks an
SM, streaming loads, a plain vector store), one ``nvcc`` each, side by
side.  At the train step's two shapes (``kernel_probe.K6_SHAPES``, its
seeded inputs) each variant is checked as ``chip_smoke.py`` phase 3 checks
the kernel (stats and dice within rtol 1e-5 of the plain version, the lse
bit-equal, dm within 1e-7 + 1e-5|x| of the plain gradient given that lse)
and timed (CUDA events behind a ~1 ms device sleep, median of 20) in two
rounds, the variants in order and then reversed.  Prints one JSON line a
variant with its registers (``cuobjdump -res-usage``) and main-loop SASS
instructions an element, one a shape and variant, then the card's name and
power limit.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import torch

from ..ops.cuda import _lib
from ..ops.cuda import mask_loss as ml
from .kernel_probe import K6_SHAPES, _k6_inputs, k6_instructions, res_usage, time_ms

# one decision undone: (text of the source, what replaces it)
EDITS = {
    "log1pf": ("log1p_01(e)) * v[k];", "log1pf(e)) * v[k];"),
    "frcp_rn": ("rcp_1_2(__fadd_rn(1.f, e));", "__frcp_rn(__fadd_rn(1.f, e));"),
    "group4": ("constexpr int GROUP = 2;", "constexpr int GROUP = 4;"),
    "group8": ("constexpr int GROUP = 2;", "constexpr int GROUP = 8;"),
    "depth4": ("constexpr int DEPTH = 2;", "constexpr int DEPTH = 4;"),
    "no_block_cap": ("__launch_bounds__(THREADS, FWD_BLOCKS_PER_SM) mask_loss_fwd",
                     "__launch_bounds__(THREADS) mask_loss_fwd"),
    "ldcs": ("return __ldg(reinterpret_cast<const float4*>(p));",
             "return __ldcs(reinterpret_cast<const float4*>(p));"),
    "plain_store": ("__stcs(reinterpret_cast<float4*>(row + px), make_float4(x[0], x[1], x[2], x[3]));",
                    "*reinterpret_cast<float4*>(row + px) = make_float4(x[0], x[1], x[2], x[3]);"),
}
# the design, then variants; "first_design" is the form this redesign
# started from (8 queries a reduction, the library's log1pf and reciprocal,
# no register cap)
VARIANTS = {
    "design": (),
    "log1pf": ("log1pf",),
    "frcp_rn": ("frcp_rn",),
    "log1pf_frcp_rn": ("log1pf", "frcp_rn"),
    "group4": ("group4",),
    "group4_depth4": ("group4", "depth4"),
    "no_block_cap": ("no_block_cap",),
    "ldcs": ("ldcs",),
    "plain_store": ("plain_store",),
    "first_design_group4": ("group4", "log1pf", "frcp_rn", "no_block_cap"),
    "first_design": ("group8", "log1pf", "frcp_rn", "no_block_cap"),
}


def sources() -> dict[str, str]:
    """Each variant's source; raises when the design source no longer holds
    a text an edit replaces."""
    src = (_lib.CSRC / "mask_loss.cu").read_text()
    for name, (old, _) in EDITS.items():
        if src.count(old) != 1:
            raise RuntimeError(f"csrc/mask_loss.cu holds {src.count(old)} of {name}'s {old!r}")
    out = {}
    for name, edits in VARIANTS.items():
        s = src
        for e in edits:
            s = s.replace(*EDITS[e])
        out[name] = s
    return out


def _build(srcs: dict[str, str]) -> dict[str, tuple]:
    """One library per variant, nvcc in parallel, under the git-ignored
    build directory: name -> (library, its path)."""
    out_dir = _lib.BUILD_DIR / "mask_loss_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in srcs.items():
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
        for kern in (ml.KERNEL, ml.KERNEL_BWD):
            fn = getattr(lib, kern.symbol)
            fn.argtypes = [*kern.argtypes, _lib.P]
            fn.restype = _lib.I32
        libs[name] = (lib, out_dir / f"{name}.so")
    return libs


def _calls(lib, m, t, pos, valid, lbl, gs, gd):
    """The forward and backward of ``lib`` on these inputs, with the
    wrapper's scratch and vector path; the outputs they write."""
    n, q, h, w = m.shape
    hw = h * w
    plan = ml.launch_plan(n, q, hw)
    scratch = torch.empty(plan.scratch_floats, device=m.device)
    stats = torch.empty((n, 2), device=m.device)
    dice = torch.empty((n, 3, q), device=m.device)
    lse = torch.empty((n, h, w), device=m.device)
    dm = torch.empty_like(m)
    vec = int(ml.vector_path(hw, m, t, valid, lbl, lse, dm))

    def check(err):
        if err:
            raise RuntimeError(f"CUDA error {err} at launch")

    def fwd():
        check(lib.poly_mask_loss_fwd(m.data_ptr(), t.data_ptr(), pos.data_ptr(), valid.data_ptr(),
                                     lbl.data_ptr(), lse.data_ptr(), scratch.data_ptr(),
                                     stats.data_ptr(), dice.data_ptr(), n, q, hw, vec,
                                     torch.cuda.current_stream().cuda_stream))

    def bwd():
        check(lib.poly_mask_loss_bwd(m.data_ptr(), t.data_ptr(), lse.data_ptr(), pos.data_ptr(),
                                     valid.data_ptr(), lbl.data_ptr(), gs.data_ptr(),
                                     gd.data_ptr(), dm.data_ptr(), n, q, hw, vec,
                                     torch.cuda.current_stream().cuda_stream))

    return fwd, bwd, (stats, dice, lse, dm)


def main() -> int:
    if not torch.cuda.is_available():
        print("mask_loss_variants: no CUDA card", file=sys.stderr)
        return 1
    srcs = sources()
    libs = _build(srcs)
    for name, (_, path) in libs.items():
        regs = {k: v for k, v in res_usage(path).items() if k.startswith("mask_loss")}
        instr = {k: v["instructions_per_element"]
                 for k, v in k6_instructions(path, srcs[name]).items()}
        print(json.dumps({"variant": name, "edits": VARIANTS[name], "res_usage": regs,
                          "instructions_per_element": instr}), flush=True)
    dev = torch.device("cuda")
    for shape in K6_SHAPES:
        m, t, pos, valid, lbl, gs, gd = _k6_inputs(dev, shape)
        ws, wd, wl = ml.mask_loss_stats_plain(m, t, pos, valid, lbl)
        want = ml.mask_loss_grad_plain(m, t, pos, valid, lbl, gs, gd, wl)
        calls, rec = {}, {}
        for name, (lib, _) in libs.items():
            fwd, bwd, (stats, dice, lse, dm) = _calls(lib, m, t, pos, valid, lbl, gs, gd)
            fwd()
            bwd()
            torch.cuda.synchronize()
            rec[name] = {
                "shape": list(shape), "variant": name,
                "stats_dice_within_rtol": bool(((stats - ws).abs() <= 1e-5 * ws.abs()).all()
                                               and ((dice - wd).abs() <= 1e-5 * wd.abs()).all()),
                "lse_bit_equal": bool(torch.equal(lse, wl)),
                "dm_within_tol": bool(((dm - want).abs() <= 1e-7 + 1e-5 * want.abs()).all()),
                "dm_bit_equal": bool(torch.equal(dm, want))}
            calls[name] = (fwd, bwd)
        for names in (list(calls), list(reversed(calls))):
            for name in names:
                fwd, bwd = calls[name]
                rec[name].setdefault("fwd_ms", []).append(time_ms(fwd))
                rec[name].setdefault("bwd_ms", []).append(time_ms(bwd))
        for r in rec.values():
            print(json.dumps(r), flush=True)
        del m, t, want, calls
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi: n/a")
    return 0


if __name__ == "__main__":
    sys.exit(main())
