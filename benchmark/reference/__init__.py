"""The benchmark's plain reference: float32 PyTorch with TF32 off, written
without any kernel, cache or batching of the program, and importing nothing
of it. The model files are frozen copies of the program's plain math;
``system.py`` wires them as the serving path does, and ``frontend.py`` works
out again what the program derives from a request."""
