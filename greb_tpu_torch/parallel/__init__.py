"""Member-batched runs (ensembles)."""
