"""Host runtime of the port: the native commit path's bindings
(``fastpath.py``)."""
