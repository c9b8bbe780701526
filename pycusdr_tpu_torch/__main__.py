from pycusdr_tpu_torch.runtime.cli import main

if __name__ == "__main__":
    raise SystemExit(main())
