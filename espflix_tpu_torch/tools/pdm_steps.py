"""Cycles a K5 bit step on one warp, for variants of the step, and the
latency of one dependent integer operation of a few kinds.

    python3 espflix_tpu_torch/tools/pdm_steps.py [--samples 1664] [--sass FILE]

builds tools/pdm_steps.cu with nvcc for sm_90a into build/ and runs, on
cuda:0, each step variant over --samples samples (2 x 16 bit steps a
sample, one lane a thread, one warp, clock64() around the loop):

  pred        K5's first form: the sign as a predicate (pos ? -A1 : A1),
              i1 updated, then i2 from it;
  mask        m = i2 >> 31 and m & 2 A1, c = i1 + i0 - A1 - A2 carried,
              the word built from the masks by shifts;
  mask_lop3   the same with the word built by one OR a step (K5's form);
  imad        the sign as 0 / 1 times the constant (a multiply-add);
  fma         the mask step with c's update and the word as multiply-adds
              on the mask (the FMA pipe) in place of ANDs and ORs;

then chains of 4,096 dependent iterations of one kind: xor then add,
shift then xor (two dependent operations each), shift + add (one
LEA.HI), a multiply-add, two shifts by registers then an xor.  Prints
one JSON line: the card's name and power limit, cycles a step per
variant, whether every variant's final state and word checksum equal
pred's, the SM clock the loop saw (cycles over %globaltimer ns), and
cycles an iteration per chain.  --sass writes cuobjdump's SASS of the
library to FILE.  Needs a CUDA card.
"""

import argparse
import ctypes
import hashlib
import json
import shutil
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
SOURCE = HERE / "pdm_steps.cu"
VARIANTS = ("pred", "mask", "mask_lop3", "imad", "fma")
CHAINS = ("xor_add", "shr_xor", "shift_add", "imad", "shift_reg")


def build(out_dir: Path) -> Path:
    from espflix_tpu_torch import build as B
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(
        B.NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = out_dir / f"pdm_steps-{digest}.so"
    if not lib.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
        subprocess.run([nvcc, *B.NVCC_FLAGS, "-shared", "-o", str(lib),
                        str(SOURCE)], check=True)
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--samples", type=int, default=1664)
    ap.add_argument("--sass", default=None)
    args = ap.parse_args()
    sys.path.insert(0, str(HERE.parents[1]))

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("pdm_steps: no CUDA device")
    from espflix_tpu_torch import build as B
    dev = torch.device("cuda:0")
    path = build(B.BUILD_ROOT)
    if args.sass:
        objdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
        Path(args.sass).write_text(subprocess.run(
            [objdump, "-sass", str(path)], capture_output=True, text=True,
            check=True).stdout)
    lib = ctypes.CDLL(str(path))
    lib.pdm_steps.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int] \
        + [ctypes.c_void_p] * 4
    lib.op_chain.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2

    g = torch.Generator(device="cpu").manual_seed(3)
    st = torch.randint(-2_000_000, 2_000_000, (32, 3), generator=g,
                       dtype=torch.int32).to(dev)
    steps = 2 * 16 * args.samples
    out, first = {}, None
    for k, name in enumerate(VARIANTS):
        so = torch.empty_like(st)
        sums = torch.empty(32, dtype=torch.int32, device=dev)
        cyc = torch.empty(1, dtype=torch.int64, device=dev)
        ns = torch.empty(1, dtype=torch.int64, device=dev)
        best = None
        for _ in range(3):          # the first run warms the code up
            rc = lib.pdm_steps(k, st.data_ptr(), args.samples, so.data_ptr(),
                               sums.data_ptr(), cyc.data_ptr(),
                               ns.data_ptr())
            if rc:
                raise RuntimeError(f"pdm_steps {name}: CUDA error {rc}")
            torch.cuda.synchronize()
            best = (int(cyc), int(ns))
        result = (so.cpu(), sums.cpu())
        first = first or result
        out[name] = dict(cycles_per_step=best[0] / steps,
                         clock_mhz=best[0] / best[1] * 1e3,
                         equal_to_pred=all(torch.equal(a, b) for a, b in
                                           zip(result, first)))
    chains = {}
    n = 4096
    for k, name in enumerate(CHAINS):
        o = torch.empty(32, dtype=torch.int32, device=dev)
        cyc = torch.empty(1, dtype=torch.int64, device=dev)
        for _ in range(3):
            rc = lib.op_chain(k, n, 0x5BD1E995, 0x1B873593, o.data_ptr(),
                              cyc.data_ptr())
            if rc:
                raise RuntimeError(f"op_chain {name}: CUDA error {rc}")
            torch.cuda.synchronize()
        chains[name] = int(cyc) / n
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    print(json.dumps({"card": smi, "samples": args.samples, "steps": steps,
                      "variants": out, "cycles_per_iteration": chains}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
