"""Accepted drafts over all steps of the requests completed in the
window, in %: Σ num_spec / Σ (num_full + num_spec)."""


def read(run):
    steps = sum(s.num_full + s.num_spec for s in run.window.served)
    if not steps:
        return None
    return 100.0 * sum(s.num_spec for s in run.window.served) / steps
