"""Native (C++) decode library and its ctypes binding."""
