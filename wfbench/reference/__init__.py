"""Plain numpy references of the configurations' results.  They import
numpy alone: nothing of the program, of the JAX package or of the
repository's tests."""
