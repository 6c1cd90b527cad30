"""The plain reference of a ``kit`` run (NumPy only; imports nothing of
the program under test)."""
