"""Graph families, one module each, found by the configuration's
``generator``."""
