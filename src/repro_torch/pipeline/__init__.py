"""Pipeline specs and the per-stage callables of the actor runtime."""
