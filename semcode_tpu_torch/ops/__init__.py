"""Hand-written device kernels, each beside its plain torch version."""
