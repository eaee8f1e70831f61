"""Serving loop shared by the port's engines (:class:`SlotLoop`)."""
