"""Settings of a pytest run of the whole repository."""


def pytest_configure(config):
    # pytest-xdist's --dist loadfile sends files out by descending test
    # count, which started tests/test_fleet_sharded.py (11 tests, ~900 s) last
    if hasattr(config.option, "loadscopereorder"):
        config.option.loadscopereorder = False
