"""The EVM constants the symbolic stepper needs (the port's copy of the
part of ``mythril_tpu/support/eth_constants.py`` that ops/symstep uses)."""

#: ArbitraryStorage probe slot: the one concrete storage key whose write
#: the module's probe constraint can satisfy. A concrete-key SSTORE to it
#: mints a sink record on device (ops/symstep.py).
ARB_PROBE_SLOT = 324345425435
