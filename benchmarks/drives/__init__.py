"""How a window drives the program, one module a kind, named by a traffic
file's ``"drive"``. Each module defines ``Drive(cell)`` with ``setup()``,
``window(rec, tracer)``, ``outputs()``, ``release()`` and
``reference(precision)``."""
