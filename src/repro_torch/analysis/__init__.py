"""Analysis tooling of the port: the memory model and the H100 roofline."""
