"""Plain references of the benchmark's model families, one module each.

Each module computes its family from a configuration file's sizes in plain
PyTorch, with no kernel and no import of the program under test. The
harness finds a configuration's reference by the file's `family` key.
"""
