"""Padded mel frames of the device batches the batcher ran, over all their
frames, in %."""

from benchmark.harness import readings


def read(run):
    return readings.pad_frames_pct(run)
