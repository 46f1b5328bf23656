"""Step functions, train state, optimizer and schedule."""
