"""Plain float32 references, one file a model family, and the weights the
benchmark makes for them.  They import nothing of the port."""
