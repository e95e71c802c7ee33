"""Multi-card placement: see :mod:`.mesh`."""
