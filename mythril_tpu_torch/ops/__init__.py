"""Device compute kernels: 256-bit limb arithmetic (bv256), the batched
lane stepper (stepper), and the interval constraint pre-filter (intervals).

Import submodules explicitly — importing this package must stay cheap and
jax-free so host-only paths (CLI parsing, disassembly) don't pay jax
startup costs.
"""
