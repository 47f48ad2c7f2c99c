"""Device milliseconds a build of host-to-device copies (the upload of the
graph's columns), from the profiler's ``Memcpy HtoD`` activity."""


def read(view):
    us = view.device_us(lambda name: name.startswith("Memcpy HtoD"))
    return None if us is None or not view.builds else us / 1e3 / view.builds
