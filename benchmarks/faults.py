"""Faults planted in the program's timed path, for the tests that show a
run's ``correct`` comes out false and for the readings that bound a
training cell's limits (``calibrate --fault``).  Each is a context manager
that patches the port where the timed path calls it and restores it."""
from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def score(fault: str):
    """``half_the_batch``: the second half of a batch's items unscored;
    ``answer_altered``: the first item's anomaly logits moved by 0.5."""
    from eventad_tpu_torch.models import dagr
    fwd = dagr.model_forward

    def broken(model, batch, *a, **kw):
        out = fwd(model, batch, *a, **kw)
        lg = out.logits.clone()
        if fault == "half_the_batch":
            lg[lg.shape[0] // 2:] = 0.0
        elif fault == "answer_altered":
            lg[0, :, 1] += 0.5
        else:
            raise ValueError(fault)
        return out._replace(logits=lg)
    return _patched(dagr, "model_forward", broken)


def stream(fault: str):
    """``state_unchanged``: a step that returns the track state it was
    given; ``answer_altered``: every logit of a step moved by 0.5."""
    from eventad_tpu_torch.streaming import incremental as inc
    make = inc.make_incremental_step
    if fault not in ("state_unchanged", "answer_altered"):
        raise ValueError(fault)

    def broken_make(*a, **kw):
        refresh, step = make(*a, **kw)

        def bad_step(state, *sa):
            new, logits = step(state, *sa)
            if fault == "state_unchanged":
                new = new._replace(h_event=state.h_event,
                                   h_coord=state.h_coord)
            else:
                logits = logits + 0.5
            return new, logits
        bad_step.append, bad_step.read_scores = step.append, step.read_scores
        return refresh, bad_step
    return _patched(inc, "make_incremental_step", broken_make)


def train_head(fault: str):
    """``state_unchanged``: the optimizer's update skipped;
    ``half_the_batch``: the loss of the first half of the items, scaled to
    the whole (the mean taken over the rest); ``answer_altered``: the loss
    moved by 1 % where it is produced."""
    from eventad_tpu_torch.parallel import train_step as ts
    if fault == "state_unchanged":
        return _patched(ts.ClippedOptimizer, "step", lambda self: None)
    fwd = ts.eventad_forward

    def broken(head, mc, feats, *a, **kw):
        if fault == "half_the_batch":
            h = feats.shape[0] // 2
            kw["loss_items"] = slice(0, h)
            out = fwd(head, mc, feats, *a, **kw)
            return out._replace(loss=out.loss * feats.shape[0] / h)
        if fault == "answer_altered":
            out = fwd(head, mc, feats, *a, **kw)
            return out._replace(loss=out.loss * 1.01)
        raise ValueError(fault)
    return _patched(ts, "eventad_forward", broken)
