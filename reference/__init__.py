"""Plain references of the applications, outside both packages: plain
PyTorch on the CPU, importing no kernel of the port and nothing of JAX."""
