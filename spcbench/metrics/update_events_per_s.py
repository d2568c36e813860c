"""update_events_per_s: every event applied and published in the window
over the window's seconds, which end at a ticket boundary."""


def read(run):
    w = run.window
    if "events" not in w or w["elapsed_s"] <= 0:
        return None
    return w["events"] / w["elapsed_s"]
