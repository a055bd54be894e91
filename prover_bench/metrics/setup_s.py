"""setup_s: seconds from the process's start to the window's opening:
imports, the NTT library's build when the checkout has none, and warming
the cell's shapes."""


def read(run):
    return run.setup_s
