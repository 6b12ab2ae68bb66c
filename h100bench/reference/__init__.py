"""The plain references that judge the program's answers."""
