from tpupt_torch.cli.main import main

raise SystemExit(main())
