"""Multi-chip scale-out: mesh construction, lane sharding, SPMD stepper
execution, collective lane accounting, and work-stealing rebalance
(parallel.mesh). Import submodules explicitly to keep jax import lazy.
"""
