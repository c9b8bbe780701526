"""The plain reference the program's outputs are judged by. It imports
nothing of the measured program."""
