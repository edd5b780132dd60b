from gyeeta_tpu_torch.cli import main

# the __name__ guard matters: the REST gateway's render pool spawns its
# children, and spawn re-imports the parent's main module in the child
# (as "__mp_main__"); an unguarded main() would re-run the CLI there
if __name__ == "__main__":
    main()
