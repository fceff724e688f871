"""Host utilities: the injectable clock (`clock`)."""
