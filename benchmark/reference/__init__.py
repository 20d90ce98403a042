"""Plain PyTorch references of what the benchmark's cells run. They
import nothing of the program and take nothing it made: the benchmark
hands both sides the same inputs and weights."""
