"""Diagnostics run by hand on a CUDA machine; nothing of the port imports them."""
