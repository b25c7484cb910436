"""Entry points: serving."""
