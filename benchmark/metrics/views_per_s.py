"""Views whose every label reached the loop inside the window,
over the window's seconds."""


def read(rec):
    return rec["views_done"] / rec["seconds"]
