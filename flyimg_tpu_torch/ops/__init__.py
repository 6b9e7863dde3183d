"""Device programs: the windowed resample and the plan -> program composer."""
