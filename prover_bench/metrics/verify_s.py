"""verify_s: seconds to verify one statement's proof in the proving
process, the mean over the window's statements."""


def read(run):
    return sum(run.verify_s) / len(run.verify_s) if run.verify_s else None
