"""The busiest expert's routed real tokens over the mean of its layer's
experts, averaged over the MoE layers, for the window: from the program's
counter (``repro_torch.serve.telemetry.EXPERT_LOAD``), read on the device
at the first encoder call at or after each end of the window.  1 is an
even load."""


def read(run):
    routed = getattr(run, "expert_load", None)
    if routed is None:
        return None
    shares = [r.max() / r.mean() for r in routed if r.sum() > 0]
    return sum(shares) / len(shares) if shares else None
