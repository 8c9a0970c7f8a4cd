"""Host time of the training batch's copy to the device per step, in ms: the
summed duration of the program's ``ds.train.h2d`` spans over its
``ds.train.step`` spans (``training/trainer.py:Trainer.prepare_batch``: the
arrays as tensors, pinned, and their non-blocking copies enqueued).

The program records spans only while a profiler records: the first 10 s of
a ``--trace 1`` window, the part ``idle_pct`` and the rooflines read, under
the profiler's host cost. None without spans (``--trace 0``, or a program
without the tracer)."""


def read(run):
    try:
        from diffsinger_tpu_torch.utils import trace
    except ImportError:
        return None
    s = trace.summary()
    if "ds.train.h2d" not in s or not s.get("ds.train.step", {}).get("count"):
        return None
    return s["ds.train.h2d"]["total_ms"] / s["ds.train.step"]["count"]
