"""Tools that gather readings on the card for setting the limits."""
