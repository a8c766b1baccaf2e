"""Device compute engine (XLA gather resample + canvas assembly) and the
merge-overlap scorer."""
