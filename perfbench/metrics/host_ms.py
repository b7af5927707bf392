"""The host's time inside the entry (``train/step.py``'s
``TrainStep.__call__`` or ``make_predict_step``'s ``predict``): from the
call to its return, before the synchronise, as the mean over the
measured window (the benchmark's own span, host clock). The part of the
name is the route: ``host_ms.train``, ``host_ms.predict``."""


def read(r, part):
    if r.route != part or not r.window.entry:
        return None
    return 1e3 * sum(r.window.entry) / len(r.window.entry)
