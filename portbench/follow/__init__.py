"""What the output check follows of the program, one module per model
family (``<family>.py``, found by name as ``reference/<family>.py`` is):
a ``Recorder`` of what a window's insertions decided and left in the
cache, ``EXACT`` (the numbers compared with limit 0) and ``readings``,
which runs the family's plain reference over a sample and returns the
numbers compared."""
