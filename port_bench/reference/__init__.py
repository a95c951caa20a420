"""The plain reference of the benchmark: what ``correct`` compares the
program's answers with. Plain PyTorch and numpy, frozen copies of the
port's math with its kernels replaced by plain versions; it imports
nothing of the program and takes nothing the program made."""
