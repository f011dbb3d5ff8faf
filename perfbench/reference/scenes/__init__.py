"""Scene recipes of the plain reference, one module per configuration's
``scene``, each with ``build(cfg, root) -> PlainScene``."""
