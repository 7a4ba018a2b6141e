"""EVM gas/protocol constants (role of the py-evm constants the reference
imports — reference machine_state.py:8-10, instruction_data.py:4-14; values
are EVM yellow-paper/EIP constants)."""

GAS_MEMORY = 3
GAS_MEMORY_QUADRATIC_DENOMINATOR = 512

GAS_SHA3 = 30
GAS_SHA3WORD = 6

GAS_ECRECOVER = 3000
GAS_SHA256 = 60
GAS_SHA256WORD = 12
GAS_RIPEMD160 = 600
GAS_RIPEMD160WORD = 120
GAS_IDENTITY = 15
GAS_IDENTITYWORD = 3

GAS_CALLSTIPEND = 2300
GAS_CALLVALUE = 9000
GAS_NEWACCOUNT = 25000

STACK_LIMIT = 1024
BLOCK_GAS_LIMIT = 8000000

# Default per-frame gas ceiling for a fresh MachineState (reference
# parity: state/global_state.py:48 uses 1_000_000_000). Transaction-level
# gas enforcement happens separately against transaction.gas_limit in
# Instruction.check_gas_usage_limit; this frame ceiling only guards
# against runaway memory-expansion fees.
FRAME_GAS_LIMIT = 1_000_000_000


def ceil32(x: int) -> int:
    return x if x % 32 == 0 else x + 32 - (x % 32)

# -- detector constants (not protocol constants, but they must be
# shared dependency-free between the analysis layer and the device
# stepper) ------------------------------------------------------------

#: ArbitraryStorage probe slot (ref arbitrary_write.py:21-28): the only
#: concrete storage key whose write the module's probe constraint can
#: satisfy. ops/symstep.py mints a device sink record for a concrete
#: write to it; modules/arbitrary_write.py builds the probe constraint
#: from it; lane_adapters routes on it.
ARB_PROBE_SLOT = 324345425435
