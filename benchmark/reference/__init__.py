"""The plain reference the benchmark holds the port to.

Plain NumPy and PyTorch, written from the configuration's description:
it imports nothing of the port and takes nothing the port's set-up made
(no tree, no compiled LM tables, no packed operands). The benchmark hands
it the same drawn inputs it hands the port.
"""
