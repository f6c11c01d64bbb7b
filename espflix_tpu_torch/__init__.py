"""espflix_tpu_torch: the decode -> signal chain and its fleet in PyTorch.

The PyTorch + CUDA port of ``espflix_tpu`` (which stays the bit-exact
reference).  Plain tensor code is PyTorch; every kernel the JAX package
wrote in Pallas is a CUDA C++ kernel under ``csrc/`` built for sm_90a at
first use (``build.py``) and bound with ctypes.

Each kernel wrapper takes its plain PyTorch version only for tensors on
the CPU; on a CUDA tensor it launches the kernel or raises.

Layout mirrors the JAX package:

    models/mpeg1.py     host ES segmentation + batch assembly, dense
                        compose (both layouts), the sliced tick decode
    models/sbc.py       batched SBC decode
    ops/vlc_scan.py     slice-row packing + the MPEG-1 slice FSM  (K1, K1F)
    ops/scan_dense.py   scan-row -> (lane, MB row) permutation + densify
    ops/idct.py         dequant + fixed-point IDCT                (K2, K2F)
    ops/mocomp.py       half-pel prediction + compose + put       (K3, K3F)
    ops/composite.py    NTSC/PAL composite field pair, parts form  (K4)
    ops/sbc_ops.py      SBC primitives
    ops/delta_sigma.py  second-order PDM                           (K5)
    runtime/chain.py    FullChain / run_full_chunk: K ticks per call
    runtime/output.py   per-lane OSD / slide / beep state, PDM state
    runtime/session.py  incremental TS -> pictures + SBC frames
    runtime/player.py   PlayerSession: play, pause, FF/RWD, seek, menu
    runtime/scheduler.py  Fleet: decode-only ticks / run_chunk, and
                        run_chunk_full (sessions -> the chain)
    tools/serve_scenario.py  the serving scenario (--stage decode, full)

Copies of the JAX package's jax-free modules, at the same paths and
pinned to their originals by tests/test_torch_isolation.py:
core/{vlc_tables,sbc_tables,bitio}.py, audio/sbc.py,
runtime/{events,checkpoint}.py, streaming/{index,streamer,native,ts}.py,
video/{clock,render,tables}.py and tools/{indexer,ts_mux,mpeg1_encode,
sbc_encode,content}.py.

Importing this package imports torch and numpy, never jax and nothing
of espflix_tpu.  Entry points run on the CUDA card unless the caller
passes device="cpu".
"""
