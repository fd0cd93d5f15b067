"""Plain references of the benchmark's configurations (no import of the
program under test)."""
