"""The repo's examples on the port, one module per script of
``examples/``: ``quickstart``, ``bitmap_analytics``, ``serve_decode``
and ``train_lm``. The fifth, the binary-LM example, is
``repro_torch.apps.binary_lm``.

Each module's ``main(argv=None, ...)`` takes the script's flags and
``--device`` (the card unless it names another; without a card the
default raises), prints the script's lines, with the backends named
``"torch"`` and ``"cuda"`` where the script names ``"jnp"`` and
``"pallas"``, and returns the figures it printed as a dict:

    PYTHONPATH=src python -m repro_torch.examples.quickstart
    PYTHONPATH=src python -m repro_torch.examples.train_lm --device cpu
"""
