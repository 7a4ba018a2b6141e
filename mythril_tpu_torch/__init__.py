"""mythril_tpu_torch: the mythril_tpu EVM security analyzer with its
device layer in PyTorch and hand-written CUDA kernels for the H100
(sm_90a).

The package imports neither JAX nor ``mythril_tpu``. Its host half (the
interpreter, the SMT layer and its solver, the detectors, the CLI) is a
copy of the JAX package's, held byte for byte against it by
``tests/test_torch_imports.py``, apart from the few seams where the
copy would hide the device. Its device half is its own:

* ``ops.symstep`` and ``ops.bv256``: the symbolic lane stepper (K0
  ``sym_init``, K1 ``sym_step``) and its 256-bit word arithmetic;
* ``laser.lane_engine``: the fused window dispatch (K2 prologue, K3
  record dedup, K4 epilogue and its gathers), the window-merge
  fingerprint (K9), and the host bridge that seeds lanes from
  ``GlobalState``s, drains records and forks into terms, and
  materializes parked lanes;
* ``ops.intervals`` and ``ops.propagate``: the solver's feasibility
  screens (K5 interval level, K6-K8 the product-domain fixpoint).

``python3 -m mythril_tpu_torch analyze ... --tpu-lanes N`` runs the
whole analyzer with the lane engine on the card. Entry points run on
the card unless the caller asks for the CPU (``device="cpu"``, or
``args.device = "cpu"`` for an analysis), where the plain PyTorch
version of each kernel runs instead.
"""

__version__ = "0.1.0"
