"""The port's counterparts of the reference's user-facing examples
(``examples/quickstart.py``, ``serve_batch.py``, ``train_lm.py`` and
``async_runtime.py``): each a module with ``main(argv=None)`` and a
``--device`` flag (default ``cuda``), run as ``python -m
repro_torch.examples.<name>``.  The reference forced 8 host devices; here
the mesh's ranks are threads of one process on one device."""
