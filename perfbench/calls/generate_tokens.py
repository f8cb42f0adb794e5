"""A mix whose ``"call"`` is ``generate_tokens``: see ``perfbench.model``."""

from perfbench.model import checks_of, run_cell  # noqa: F401
