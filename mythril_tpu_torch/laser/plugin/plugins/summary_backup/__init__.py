"""Placeholder package (reference parity:
mythril/laser/plugin/plugins/summary_backup/ is an empty placeholder for
a symbolic-summaries plugin)."""
