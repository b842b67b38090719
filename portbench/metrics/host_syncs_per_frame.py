"""host_syncs_per_frame (facade): the host syncs that
``torch.cuda.set_sync_debug_mode("warn")`` warns of, a lower bound, per
window frame outside the profiled slice."""


def read(run):
    s = [n for n, traced in zip(run.syncs, run.traced) if not traced]
    return sum(s) / len(s) if s else None
