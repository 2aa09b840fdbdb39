"""Actor runtime (copied verbatim from the reference) and its helpers."""
