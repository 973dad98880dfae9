"""setup.model_s: host seconds of the ``build_*model`` call of
``drivers/hitu.py`` or ``drivers/ph1.py``, ending in a device sync (the
benchmark's own span around it)."""


def read(ctx):
    return ctx["setup"]["model_s"]
