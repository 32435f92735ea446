from ia_spgemm_tpu_torch.cli.main import main

raise SystemExit(main())
