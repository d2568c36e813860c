"""query_qps: every pair answered in the window over the window's
seconds, on the host clock."""


def read(run):
    w = run.window
    if "pairs" not in w or w["elapsed_s"] <= 0:
        return None
    return w["pairs"] / w["elapsed_s"]
