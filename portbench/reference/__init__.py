"""Plain references the checks hold the program's outputs against.

Nothing here imports the program; a table is read with the frozen
format reader of ``tables.py``.
"""
