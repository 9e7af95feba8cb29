"""The benchmark's plain references: plain torch and numpy, importing
nothing of the program under test."""
