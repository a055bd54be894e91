"""prove_s: seconds to prove one statement (its trace build, LDE and whole
proof), the mean over the window's statements."""


def read(run):
    return sum(run.prove_s) / len(run.prove_s) if run.prove_s else None
