"""setup.import_s: seconds from the process's start to the port imported
and its CUDA library loaded."""


def read(ctx):
    return ctx["setup"]["import_s"]
