from rays1bench.bench.cli import main

main()
