"""The benchmark's plain reference: float32 PyTorch forwards of the served
architectures, written from their published equations, that import nothing
of the program under test, with the parameter layout both sides are handed
and the counts of operations and bytes of a call.

Each model entry of a configuration (``configs/<config>.json``) may name
its reference module beside ``arch``, ``source`` and ``config``:
``"reference": "<module>"``, a module of this package; without the key it
is ``model``. A new architecture brings its own module as a new file.
``harness.reference_module`` imports it and checks, at set-up, that it
serves, for each model entry ``cfg`` (the entry's ``config``, with a
supernet variant's keys replaced):

* ``check_config(cfg)``: raise on a feature the module does not compute;
* ``param_layout(cfg)``: every leaf as ``(path, shape, kind, fan_in)``,
  ``kind`` one of ``weights``' kinds;
* ``forward(params, cfg, tokens, quant=None, routed=None)``: float32 logits
  ``[S, V]``; ``quant="fp8"`` is the control;
* ``variant_tree(tree, cfg)``: a supernet variant's weights cut from its
  model's tree (views);
* ``call_counts(cfg, s, live_experts=None)``: one call's operations and
  bytes, in ``counts.call_counts``' shape.

and may define, where ``model``'s do not fit:

* ``COMPUTE_KINDS``: the leaf kinds served in the configuration's dtype,
  the rest in float32 (``weights.plan``);
* ``TINY``: the widths, and with ``num_layers`` the depth, of its models'
  stand-ins in the CPU tests (``tests/tiny.py``), and
  ``TINY_VARIANT_LAYERS``: the depth of each of their supernet variants.
"""
