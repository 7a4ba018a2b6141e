"""The term DAG and its host interval domain, copied from
``mythril_tpu/smt`` (``terms.py`` and ``interval.py`` verbatim), and the
solver counters the device screens bump."""
