"""Seconds of audio the window's calls returned over the window's wall seconds."""

from benchmark.harness import readings


def read(run):
    return readings.audio_s_per_s(run)
