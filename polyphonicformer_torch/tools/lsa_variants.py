"""What each design decision of K5 is worth, on one CUDA card.

    python -m polyphonicformer_torch.tools.lsa_variants

Builds ``csrc/lsa.cu`` as it stands and with one of its decisions undone
(``VARIANTS``: five ``__shfl_xor_sync`` rounds over the packed 64-bit key
in place of the two ``__reduce_min_sync``; a branch around each slot's
relaxation and shared load in place of the straight-line slots; the
preparation as a pass over the valid rows after the copy in place of the
one on each read; plain loads in place of the asynchronous copy), one
``nvcc`` each, side by side.  On the problems of one full-width
``image_r50_2x`` train step (``kernel_probe._train_step_lsa_problems``),
the same with no valid row (launch, ballot and the skipped copy), and
phase 3's distribution (``kernel_probe._phase3_lsa_problems``), each
variant is checked against the plain solver (equal assignments) and timed
(CUDA events behind a ~1 ms device sleep, median of 20) in two rounds, the
variants in order and then reversed.  Prints one JSON line a variant with
its registers (``cuobjdump -res-usage``), one a problem set and variant,
then the card's name and power limit.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import torch

from ..ops.cuda import _lib
from ..ops.cuda import lsa
from .kernel_probe import _phase3_lsa_problems, _train_step_lsa_problems, res_usage, time_ms

_REDUX = """        const unsigned mm = __reduce_min_sync(FULL, m);
        const unsigned lw = __reduce_min_sync(FULL, m == mm ? low : ~0u);
        const int j = static_cast<int>(lw >> 11);
        const int next = static_cast<int>(lw & 0x7ffu) - 1;
        min_val = from_ordered(mm);
"""
_BUTTERFLY = """        unsigned long long key = (static_cast<unsigned long long>(m) << 32) | low;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          const unsigned long long o = __shfl_xor_sync(FULL, key, off);
          key = o < key ? o : key;
        }
        const int j = static_cast<int>(static_cast<unsigned>(key) >> 11);
        const int next = static_cast<int>(static_cast<unsigned>(key) & 0x7ffu) - 1;
        min_val = from_ordered(static_cast<unsigned>(key >> 32));
"""
_RELAX = """        for (int s = 0; s < CPL; ++s) {
          r[s] = __fsub_rn(__fsub_rn(__fadd_rn(min_val, prepare(row[s * 32])), ui), v[s]);
        }
#pragma unroll
        for (int s = 0; s < CPL; ++s) {
          const bool better = (rem & (1u << s)) && r[s] < spc[s];
          spc[s] = better ? r[s] : spc[s];
          path[s] = better ? i : path[s];
          ord[s] = rem & (1u << s) ? ordered(spc[s]) : ~0u;
        }
"""
_BRANCH_RELAX = """        for (int s = 0; s < CPL; ++s) {
          if (rem & (1u << s)) {
            r[s] = __fsub_rn(__fsub_rn(__fadd_rn(min_val, prepare(row[s * 32])), ui), v[s]);
            if (r[s] < spc[s]) {
              spc[s] = r[s];
              path[s] = i;
            }
          }
          ord[s] = rem & (1u << s) ? ordered(spc[s]) : ~0u;
        }
"""
_WAIT = """  asm volatile("cp.async.wait_all;\\n" ::: "memory");
}
"""
_PREP_PASS = """  asm volatile("cp.async.wait_all;\\n" ::: "memory");
  __syncwarp();
  for (int w = 0; w < NW; ++w) {
    for (unsigned bits = vbits[w]; bits; bits &= bits - 1) {
      float* row = cost + (w * 32 + __ffs(bits) - 1) * PS;
#pragma unroll
      for (int s = 0; s < CPL; ++s) {
        if (s * 32 + lane < P) row[s * 32 + lane] = prepare(row[s * 32 + lane]);
      }
    }
  }
}
"""
# one decision undone: (text of the source, what replaces it)
EDITS = {
    "butterfly": (_REDUX, _BUTTERFLY),
    "branch_relax": (_RELAX, _BRANCH_RELAX),
    "prep_pass": (_WAIT, _PREP_PASS),
    "prep_pass_read": ("__fadd_rn(min_val, prepare(row[s * 32]))", "__fadd_rn(min_val, row[s * 32])"),
    "sync_copy_t": ("copy4(on, dst + p, src + p * sp);", "if (on) dst[p] = src[p * sp];"),
    "sync_copy_r": ("copy4(p < P, cost + g * PS + p, c + g * sg + p * sp);",
                    "if (p < P) cost[g * PS + p] = c[g * sg + p * sp];"),
}
VARIANTS = {
    "design": (),
    "butterfly": ("butterfly",),
    "branch_relax": ("branch_relax",),
    "prep_pass": ("prep_pass", "prep_pass_read"),
    "sync_copy": ("sync_copy_t", "sync_copy_r"),
}


def sources() -> dict[str, str]:
    """Each variant's source; raises when the design source no longer holds
    a text an edit replaces."""
    src = (_lib.CSRC / "lsa.cu").read_text()
    for name, (old, _) in EDITS.items():
        if src.count(old) != 1:
            raise RuntimeError(f"csrc/lsa.cu holds {src.count(old)} of {name}'s {old!r}")
    out = {}
    for name, edits in VARIANTS.items():
        s = src
        for e in edits:
            s = s.replace(*EDITS[e])
        out[name] = s
    return out


def _build(srcs: dict[str, str]) -> dict[str, tuple]:
    """One library per variant, nvcc in parallel, under the git-ignored
    build directory: name -> (its ``poly_lsa``, the library's path)."""
    out_dir = _lib.BUILD_DIR / "lsa_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in srcs.items():
        cu = out_dir / f"{name}.cu"
        cu.write_text(src)
        procs[name] = subprocess.Popen(
            [_lib._nvcc(), *_lib.NVCC_FLAGS, "-shared", "-o", str(out_dir / f"{name}.so"),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    out = {}
    for name, p in procs.items():
        _, err = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{err[-3000:]}")
        fn = ctypes.CDLL(str(out_dir / f"{name}.so")).poly_lsa
        fn.argtypes = [*lsa.KERNEL.argtypes, _lib.P]
        fn.restype = _lib.I32
        out[name] = (fn, out_dir / f"{name}.so")
    return out


def _call(fn, costs, valid):
    """``fn`` on these problems as the wrapper launches it; the output it
    writes."""
    n, g, p = costs.shape
    out = torch.empty((n, g), dtype=torch.int32, device=costs.device)

    def run():
        err = fn(costs.data_ptr(), *costs.stride(), valid.data_ptr(), *valid.stride(),
                 out.data_ptr(), n, g, p, lsa.launch_plan(g, p).cpl,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"CUDA error {err} at launch")

    return run, out


def main() -> int:
    if not torch.cuda.is_available():
        print("lsa_variants: no CUDA card", file=sys.stderr)
        return 1
    libs = _build(sources())
    for name, (_, path) in libs.items():
        regs = {k: v for k, v in res_usage(path).items() if k.startswith("lsa_kernel")}
        print(json.dumps({"variant": name, "edits": VARIANTS[name], "res_usage": regs}),
              flush=True)
    dev = torch.device("cuda")
    train = _train_step_lsa_problems(dev)[0]
    sets = {"train_step": train, "train_step_no_valid_row": (train[0], torch.zeros_like(train[1])),
            "phase3": _phase3_lsa_problems(dev)}
    for set_name, (costs, valid) in sets.items():
        want = lsa.solve_lsa_plain(costs.cpu(), valid.cpu())
        calls, rec = {}, {}
        for name, (fn, _) in libs.items():
            run, out = _call(fn, costs, valid)
            run()
            torch.cuda.synchronize()
            rec[name] = {"problems": set_name, "shape": list(costs.shape), "variant": name,
                         "equal_to_plain": bool(torch.equal(out.cpu(), want))}
            calls[name] = run
        for names in (list(calls), list(reversed(calls))):
            for name in names:
                rec[name].setdefault("ms", []).append(time_ms(calls[name]))
        for r in rec.values():
            print(json.dumps(r), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi: n/a")
    return 0


if __name__ == "__main__":
    sys.exit(main())
