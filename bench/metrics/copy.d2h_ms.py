"""Device milliseconds a build of device-to-host copies (the drains of the
block counts and the pid history's fetch), from the profiler's
``Memcpy DtoH`` activity."""


def read(view):
    us = view.device_us(lambda name: name.startswith("Memcpy DtoH"))
    return None if us is None or not view.builds else us / 1e3 / view.builds
