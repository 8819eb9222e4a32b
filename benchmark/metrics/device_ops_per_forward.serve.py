"""Device ops of the traced requests per served forward in them."""


def read(t):
    forwards = t["work"].get("forwards")
    return len(t["device"]) / forwards if forwards else None
