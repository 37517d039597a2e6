"""Plain PyTorch references, one module per model family (``<family>.py``),
found by the family name in a configuration's file. They import nothing of
the program and take nothing it made: the harness hands them the weights it
drew and the tokens the program served."""
