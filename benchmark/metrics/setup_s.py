"""Seconds from the process's start to the window's: import, CUDA context, the
program built with the benchmark's weights, the cell's shapes warmed."""

def read(run):
    return run["setup_s"]
