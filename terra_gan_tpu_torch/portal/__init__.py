"""Bearer-token helpers shared with the annotation portal."""
