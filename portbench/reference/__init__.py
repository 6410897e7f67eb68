"""The benchmark's plain reference: Python integers and NumPy only.  It
imports nothing of the program under test."""
