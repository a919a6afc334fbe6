"""The plain PyTorch reference the benchmark holds the program against;
it imports nothing of the program."""
