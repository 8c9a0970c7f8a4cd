"""How full the denoiser stack's waves were, in %: the 64-row tiles its
float32 tensor-core calls ran (the program's ``ds.stack.tiles`` counter)
over the slots of the waves they took (``ds.stack.slots``: per call
ceil(tiles / resident) · resident, resident the tiles the card holds at once
at the call's column split; ``ops/diffnet_stack.py``).

The program counts only while a profiler records: the first 10 s of a
``--trace 1`` window. None without the counters (``--trace 0``, or a
program that has none)."""


def read(run):
    try:
        from diffsinger_tpu_torch.utils import trace
    except ImportError:
        return None
    s = trace.summary()
    tiles, slots = s.get("ds.stack.tiles"), s.get("ds.stack.slots")
    if not tiles or not slots or not slots.get("total"):
        return None
    return 100.0 * tiles["total"] / slots["total"]
