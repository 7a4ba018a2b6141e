"""mythril_tpu_torch: the lane engine's device layer in PyTorch, with
hand-written CUDA kernels for the H100 (sm_90a).

A port of the device half of ``mythril_tpu`` that imports neither JAX
nor ``mythril_tpu``: the symbolic lane stepper (``ops.symstep``, kernel
K1), its 256-bit word arithmetic (``ops.bv256``), and the fused window
dispatch of the lane engine (``laser.lane_engine``, kernels K2-K4).
Entry points run on the card unless the caller passes ``device="cpu"``,
where the plain PyTorch versions run instead.
"""
