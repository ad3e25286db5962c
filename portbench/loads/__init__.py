"""One load a traffic kind: set-up, the window, and the check."""
