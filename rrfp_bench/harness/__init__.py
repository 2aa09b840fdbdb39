"""The benchmark's harness: the manifest, the weights, the program's run,
its trace, and the comparison that decides ``correct``."""
