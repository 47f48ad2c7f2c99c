from .engine import ServeEngine, ServeStats

__all__ = ["ServeEngine", "ServeStats"]
