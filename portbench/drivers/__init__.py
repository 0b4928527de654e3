"""The general traffic generators; a traffic file names one by its
``driver`` key."""
