"""Hold a preset object against the numbers of a configuration file."""


def check(obj, values: dict, where: str):
    """Every key of ``values`` (nested dicts for nested presets) must equal
    the attribute of ``obj`` of that name; tuples compare as lists."""
    for key, want in values.items():
        have = getattr(obj, key)
        if isinstance(want, dict):
            check(have, want, f"{where}.{key}")
            continue
        have = list(have) if isinstance(have, tuple) else have
        if have != want:
            raise SystemExit(f"{where}.{key} is {have} in the preset, {want} "
                             f"in the configuration file")
