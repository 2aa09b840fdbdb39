"""Model families: what the benchmark knows of a model, one module each.

A configuration file names its family under ``"family"``, and
:func:`rrfp_bench.harness.manifest.family` imports
``rrfp_bench/families/<family>.py`` (the name is a Python identifier).  A
family module exposes:

* ``pattern(c)``: the kind of each layer, in order.
* ``layer_leaves(c, kind)``: path -> (shape, torch dtype, std) of the
  weights of one layer of ``kind`` (std 0: zeros).
  :mod:`rrfp_bench.harness.weights` stacks each path over the layers that
  have it, orders the leaves and draws them from the seed.
* ``Reference(c, params, rows, precision)``: the plain model over the
  drawn leaves, with ``loss_sum(tokens, labels, embeds=None)``, the summed
  token cross-entropy; and ``per_microbatch(c)``: whether the reference
  has to take a step's rows a microbatch at a time (else a row at a time).
* ``model_flops(c, rows, seq)``: the training FLOPs of one step.
* ``attention_calls(c)``: one ``(window, causal)`` per attention layer, in
  layer order (window 0: none); the K1 and K1b readers price each call.
* ``check_program(c, cfg)``: the program's own config ``cfg`` against
  ``c``, ``{field: (program, benchmark)}`` for each that differs.
* ``small(c)``: the toy cut of the CPU tests: the cut configuration, the
  program config's field updates (a nested group as a dict of its
  fields), and the traffic's updates.

A family imports nothing of the program: it holds the reference.
"""
