"""Hand-written Hopper kernels of the port, their plain PyTorch versions,
and the host-side layout builders.  Importing this package builds
nothing: a kernel is compiled at its first launch (`_build`)."""
