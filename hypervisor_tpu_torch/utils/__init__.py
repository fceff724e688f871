"""Host utilities: the injectable clock (`clock`) and the status-code
tables (`status`)."""
