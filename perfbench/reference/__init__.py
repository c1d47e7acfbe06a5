"""The plain reference that decides `correct` (torch and numpy only)."""
