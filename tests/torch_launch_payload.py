"""A stand-in CLI for ``tests/test_torch_parallel.py``'s launcher test (not
a test module: pytest does not collect it): ``main([n])`` returns n frame
names, a result whose pickle is larger than a pipe holds."""


def main(argv):
    return [f"frame_{i:08d}.png" for i in range(int(argv[0]))]
