"""Device milliseconds a build spent in its levels: the sum of the
program's ``build.level`` events, each the time between two CUDA events
recorded around one level's launches (iteration 0 and every step, those
dispatched past the fixpoint included), so a level's bubbles count."""


def read(view):
    ms = [e["attrs"]["device_ms"] for e in view.events
          if e["name"] == "build.level"]
    return sum(ms) / view.builds if ms and view.builds else None
