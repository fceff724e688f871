"""The five-panel governance dashboard (`app`) and its stdlib browser
server (`web`)."""
