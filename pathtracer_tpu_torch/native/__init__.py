"""The port's native host runtime: a C++ OBJ parser and PNG encoder
(``src/ptnative.cpp``), built with g++ at first use (``build.py``) and
called through ctypes (``bindings.py``)."""
