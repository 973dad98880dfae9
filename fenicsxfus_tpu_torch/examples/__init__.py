"""The port of the JAX package's ``examples/``: one module per script, run as
``python -m fenicsxfus_tpu_torch.examples.<name>`` with the script's
arguments (and ``--device cpu`` for the CPU). ``examples/README.md`` here
maps each script to its module and says what holds it."""
