"""host_syncs_per_event.insert: the program's BFS host syncs
(``repro_torch.core.bfs.frontier_syncs``) in the window over the events
applied in it."""


def read(run):
    w = run.window
    if not w.get("events") or "frontier_syncs" not in w:
        return None
    return w["frontier_syncs"] / w["events"]
